"""Command-line entry points: training, data synthesis and evaluation."""
