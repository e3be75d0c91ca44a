"""Steganography: a file's bits hidden in network weights."""
