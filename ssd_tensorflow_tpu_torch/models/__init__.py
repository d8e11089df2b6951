"""Layers, the VGG-16 trunk and the SSD-VGG detector."""
