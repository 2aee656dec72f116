"""Utilities: fault injection for the crash-resume tests."""
