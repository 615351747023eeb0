"""FAST detection, oriented BRIEF description, Hamming matching."""
