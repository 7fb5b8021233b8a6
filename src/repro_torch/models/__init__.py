"""The decoder-only LM: blocks and the stacked transformer."""
