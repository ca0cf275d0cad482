"""Host input pipeline of the port (clips for the robustness sweep)."""
