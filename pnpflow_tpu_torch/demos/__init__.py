"""Demos of the port: the 2-D toy, the scripted restoration and the Dirichlet-simplex flows."""
