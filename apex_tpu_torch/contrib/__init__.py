"""Contributed fused ops."""
