"""sgnerf_tpu_torch — the PyTorch + CUDA port of sgnerf_tpu for NVIDIA Hopper.

The JAX package `sgnerf_tpu` is the reference; module paths here mirror it.
This package imports torch and never jax, the JAX package or bench.py: it
keeps its own copies of the numpy-only pieces it needs (the flag table,
checkpoint I/O, metrics, the visualizer, the ply reader, the room scan,
the editor, the camera path, IoU scoring and the ScanNet data tools).

Slice 1 is the eval render of the default `viewmlp` config in world
coordinates: `run/test_ft.py` -> `SceneModel.render_image` ->
`renderer.render_rays`, with hand-written CUDA kernels K1
(`ops/fused_knn.py`) and K2 (`ops/fused_agg.py`). Slice 2 is the fine-tune
train step: `run/train_ft.py` -> `SceneModel.optimize` ->
`models/train.py train_step`, whose aggregator backward is kernel K3
(`ops/fused_agg.py fused_block1_alpha_bwd`). Entry points run on
cuda:<--gpu_ids>; `--gpu_ids -1` (or `device="cpu"`) runs the kernels'
plain PyTorch versions on the CPU.
"""

__version__ = "0.2.0"
