"""Example training scripts of the port."""
