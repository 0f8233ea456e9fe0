"""Training: the train step and its optimizer."""
