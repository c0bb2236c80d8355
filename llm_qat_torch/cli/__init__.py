"""Command-line entry points: training and data synthesis."""
