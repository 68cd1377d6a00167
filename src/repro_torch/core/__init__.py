"""Technique configuration, device resolution and SSD reference math."""
