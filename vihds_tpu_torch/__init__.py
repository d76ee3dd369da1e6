"""VI-HDS in PyTorch for an NVIDIA Hopper GPU.

The second package of the repository, beside the JAX reference
``vihds_tpu``.  It imports ``torch`` and never ``jax``, and nothing of
``vihds_tpu``: the host layer (config, CSV parsing, datasets, the parameter
program) is its own copy.  Every Pallas kernel of the JAX package on a ported
path becomes a hand-written CUDA kernel under ``vihds_tpu_torch/csrc``, built
at first use with ``nvcc`` and bound with ``ctypes``; on a CPU tensor each
wrapper runs the kernel's plain PyTorch version instead.

What is ported so far, for dr_constant v1/v2 and dr_constant_precisions
v1/v2: the serving path (``vihds_tpu_torch.predict``: new plate-reader CSVs
-> amortised q(theta | x) -> K theta draws -> the fused ODE forward kernel
-> IWAE-weighted posterior predictions) and training on one split
(``vihds_tpu_torch.run_xval``, the fused ODE kernels forward and backward).
Public layouts follow the JAX package: ``observations[B,S,T]``,
``u[B,K,n_theta]``, integrator trajectories ``[T,B,K,S]`` and
``x_states[B,K,S,T]``.
"""

__version__ = "0.1.0"
