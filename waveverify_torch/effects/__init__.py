"""Audio effects of the robustness sweep and the training bank (the JAX
package's whole on-device catalog), the training augmentations, and the
host-side effect scheduler."""
