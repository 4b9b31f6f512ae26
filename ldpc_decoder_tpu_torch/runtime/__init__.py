"""Decoder runtime: parameters, host data generation, orchestration."""
