"""The PyTorch/CUDA port of ``multiview_inpaint_tpu``.

Same subpackage layout as the JAX package, module for module, so row i
of a port tensor is row i of the reference array:

- ``gs``        — gaussian scene state, PLY/COLMAP I/O, cameras, scenes.
- ``ops``       — KNN init and the splat rasterizer, whose TPU kernels are
                  hand-written CUDA for Hopper (``csrc/``).
- ``diffusion`` — the multi-view SVD inpainting model (VideoUNet,
                  ControlNet, VAE, CLIP tower, Euler-EDM sampling), whose
                  long self-attention runs a hand-written CUDA
                  flash-attention kernel.
- ``data``      — the SVD inference dataset.
- ``pipelines`` — stage CLIs (``render``, ``train_gs``, ``svd_test``).
- ``utils``     — SH, schedules, graphics, synthetic scenes.
- ``kernels``   — builds, binds and counts the CUDA kernels of ``csrc/``.

The port imports ``torch`` and never ``jax``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
