"""Evaluation: block perplexity and the zero-shot multiple-choice harness."""
