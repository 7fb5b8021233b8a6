"""LM building blocks: layers, GQA attention, Mamba2 (SSD)."""
