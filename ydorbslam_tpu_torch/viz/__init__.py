"""Headless rendering of the map and the tracked frame (numpy and PIL)."""
