"""Numerical ops: solvers, log-likelihoods and the fused CUDA integrators."""
