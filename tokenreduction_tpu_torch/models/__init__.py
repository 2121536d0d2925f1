"""Backbones, registry and weight bridge."""
