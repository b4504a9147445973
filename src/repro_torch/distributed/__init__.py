"""Fault tolerance on the host (multi-device sharding comes with ROADMAP
Queue 1 item 14)."""
