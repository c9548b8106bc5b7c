"""VMG modules in PyTorch, channels-last ``(B, T, H, W, C)`` at every public
boundary, parameter names following the reference state-dict keys."""
