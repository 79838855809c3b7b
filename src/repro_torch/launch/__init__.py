"""Launchers of the port: DSGD training and its topology helper."""
