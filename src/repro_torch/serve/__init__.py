"""The meshless serving engine."""
