"""Serving: waveform -> spoof score."""
