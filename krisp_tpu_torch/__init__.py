"""krisp_tpu_torch: the krisp_tpu engine in PyTorch, with hand-written CUDA
kernels for one NVIDIA H100 (sm_90a).

The package sits beside ``krisp_tpu`` (the JAX reference) and imports
``torch``, never ``jax``, and nothing of ``krisp_tpu``: it keeps its own
copies of krisp_tpu's framework-free host modules (``dna``, ``io``,
``engine.groups``, ``engine.render``, ``engine.checkpoint``, ``thermo``,
``nativebuild``), and builds its own C++ host helpers from
``csrc/host/``.  Every public entry takes an explicit ``device``; the
default is ``"cuda"``, and the CPU runs the kernels' plain PyTorch versions only when
asked for by name.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
