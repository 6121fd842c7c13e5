"""Model code of the port: CLIP towers and their building blocks."""
