"""Quantizer math and compressed serving artifacts."""
