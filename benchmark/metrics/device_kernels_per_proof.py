"""Device kernels one steady prove launches (torch.profiler, CUDA activity;
copies and fills left out): every eager tensor operation is one."""


def read(run):
    return float(run.profile["trace"].kernels()) if run.profile else None
