"""Audio effects of the robustness sweep and the training bank, the
training augmentations, and the host-side effect scheduler (part of the
JAX package's effect catalog)."""
