"""Seekable ChaCha8 keystream (the reference's PRNG)."""
