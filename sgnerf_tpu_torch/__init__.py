"""sgnerf_tpu_torch — the PyTorch + CUDA port of sgnerf_tpu for NVIDIA Hopper.

The JAX package `sgnerf_tpu` is the reference; module paths here mirror it.
This package imports torch and never jax. It reads the numpy-only modules of
the reference read-only: the flag table (`sgnerf_tpu.options.options`),
checkpoint I/O, metrics, the visualizer and the ply reader.

Slice 1 covers the eval render of the default `viewmlp` config in world
coordinates: `run/test_ft.py` -> `SceneModel.render_image` ->
`renderer.render_rays`, with two hand-written CUDA kernels
(`ops/fused_knn.py`, `ops/fused_agg.py`).
"""

__version__ = "0.1.0"
