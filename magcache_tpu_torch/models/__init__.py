"""DiT model families ported so far: Wan2.1 (t2v)."""
