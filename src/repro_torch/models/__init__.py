"""The dense decoder LM and its layers."""
