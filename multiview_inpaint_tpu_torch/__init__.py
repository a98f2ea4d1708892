"""The PyTorch/CUDA port of ``multiview_inpaint_tpu``.

Same subpackage layout as the JAX package, module for module, so row i
of a port tensor is row i of the reference array:

- ``gs``        — gaussian scene state, PLY/COLMAP I/O, cameras, scenes.
- ``ops``       — KNN init and the splat rasterizer, whose TPU kernels are
                  hand-written CUDA for Hopper (``csrc/``).
- ``diffusion`` — the multi-view SVD inpainting model (VideoUNet,
                  ControlNet, VAE, CLIP tower, Euler-EDM sampling, the
                  diffusion losses), whose long self-attention runs
                  hand-written CUDA flash-attention kernels (forward and
                  backward).
- ``data``      — the SVD inference and training datasets, warp maps.
- ``parallel``  — the ControlNet train step: Adam as optax, EMA.
- ``pipelines`` — stage CLIs (``render``, ``train_gs``, ``svd_test``,
                  ``svd_train``).
- ``utils``     — SH, schedules, graphics, synthetic scenes.
- ``kernels``   — builds, binds and counts the CUDA kernels of ``csrc/``.
- ``telemetry`` — spans and counters of the layers (off by default), on
                  the clock of ``torch.profiler``'s trace.

The port imports ``torch`` and never ``jax``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
