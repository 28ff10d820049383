"""Training: the train state with its Adam update, and the trainer."""
