"""Trainers: flow matching and the gradient-step denoiser."""
