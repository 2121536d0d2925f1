"""Training: losses, schedules, the grouped optimizer and the train step."""
