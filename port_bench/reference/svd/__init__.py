"""The plain reference of the SVD cells: frozen copies of the port's
plain diffusion modules (``layers``, ``resblock``, ``transformer``,
``unet``, ``controlnet``, ``vae``, ``clip_vit``, ``conditioners``,
``edm``, ``guiders``) with the attention of ``attention.py`` in place of
the port's kernel route, the clip and the training step around them
(``model``, ``train``), and the control's float8 arithmetic (``lowp``).
Nothing here imports the program."""
