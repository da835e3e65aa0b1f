"""Training: optimizers, learning-rate schedules and the train step."""
