"""The plain reference that decides ``correct``: a STARK verifier and the
AIRs of the benchmark's configurations on Python ints, BLAKE3 in Python,
and Rescue128 for the Lamport+ public keys.  It imports neither the program
nor JAX."""
