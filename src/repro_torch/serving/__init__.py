"""Serving engine, scheduler, block manager and the real backend."""
