"""Trainers: flow matching."""
