"""Numeric helpers: SH, schedules, graphics, synthetic scenes."""
