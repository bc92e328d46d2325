"""repro_torch: the PyTorch/CUDA port of the user-transparent serving
stack.

User scripts go through ``repro_torch.api`` (``api.load(arch) ->
Session``); everything else is runtime the Session owns.  The package
imports torch and numpy only — never jax, never the JAX package.
"""
