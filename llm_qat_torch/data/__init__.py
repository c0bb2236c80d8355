"""Data: the jsonl -> fixed-block pipeline and data-free synthesis from the teacher."""
