from .channel import ProverChannel
from .domain import StarkDomain
from .pipeline import Prover
from .trace import TraceTable
