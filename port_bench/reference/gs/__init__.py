"""The plain reference of the splat cells: frozen copies of the port's
plain rasterizer math (``geometry``, ``binning`` with ``keys``,
``composite``, ``sh``, ``losses``) and the render and train step around
them (``model``). Nothing here imports the program."""
