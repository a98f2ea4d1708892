"""Stage CLIs."""
