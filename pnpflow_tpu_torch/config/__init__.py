"""Model and training configurations of the port."""
