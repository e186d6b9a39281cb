"""Trainers (flow matching, the gradient-step denoiser, reflow) and the
rectified-flow samplers."""
