"""KD-QAT training for the port."""
