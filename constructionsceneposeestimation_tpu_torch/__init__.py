"""ConstructionScenePoseEstimation on PyTorch and CUDA (NVIDIA Hopper).

The datagen main path of ``constructionsceneposeestimation_tpu`` ported to
PyTorch: batched scene sampling, analytic ray-cast rendering, annotation and
Gaussian heatmap targets. The JAX package stays the reference; this package
imports ``torch`` and ``numpy`` only, never ``jax``.

Layers (bottom-up, each named like its JAX counterpart):
  core      geometry and camera math on tensors
  scene     class taxonomy, proxy assets (numpy copies), articulation, world
  sample    domain-randomization samplers driven by ``torch.Generator``s
  render    packed ray caster, pixel-sweep and RGB kernels, annotation pass
  ops       Gaussian heatmap targets and their kernel
  parallel  the batched generate step (``Pipeline.make_generate_fn``)
  csrc      the hand-written CUDA kernels (built with nvcc at first use)

Every kernel has a plain PyTorch version beside it. The device decides the
dispatch: a CUDA tensor launches the kernel, a CPU tensor takes the plain
version.
"""

__version__ = "0.1.0"
