"""Detectors: fixed threshold, adaptive freeze threshold, and the
fixed-capacity event buffers they fill."""
