"""Attention helpers (the single-device dense path and the hook attach/detach loops)."""
