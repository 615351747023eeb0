"""The online reconstruction loop."""
