"""Audio effects the robustness sweep applies (part of the JAX package's
effect catalog)."""
