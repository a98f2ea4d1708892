"""Trainers (the gaussian-splatting trainer)."""
