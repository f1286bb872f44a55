"""LM serving steps (``serve_step``); training waits for its slice."""
