"""The PyTorch/CUDA port of ``multiview_inpaint_tpu``.

Same subpackage layout as the JAX package, module for module, so row i
of a port tensor is row i of the reference array:

- ``gs``        — gaussian scene state, PLY/COLMAP I/O, cameras, scenes.
- ``ops``       — KNN init and the splat rasterizer, whose TPU kernels are
                  hand-written CUDA for Hopper (``csrc/``).
- ``pipelines`` — stage CLIs (``render``).
- ``utils``     — SH, schedules, graphics, synthetic scenes.

The port imports ``torch`` and never ``jax``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
