"""The plain reference of the SDS cell: Stable Diffusion 2 inpainting
as the score-distillation prior of a splat scene. ``unet`` (the 9-channel
UNet2D), ``prior`` (the KL encoder and the SDS loss) and ``step`` (one
SDS step on the splats), built from ``reference/svd``'s blocks and
``reference/gs``'s renderer. Nothing here imports the program."""
