"""Guidance for the stage-2 tools: CLIP text grounding."""
