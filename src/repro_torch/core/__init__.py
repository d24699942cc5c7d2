"""The paper's method in PyTorch: MC-dropout scoring, acquisition, the
masked active pool, Eq. 1 aggregation, the vectorized engine and the
fog/edge round loop."""
