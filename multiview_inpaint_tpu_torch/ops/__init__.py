"""Compute ops: KNN init and the splat rasterizer."""
