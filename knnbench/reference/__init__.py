"""The plain reference: what decides ``correct``. Imports numpy and torch
only: nothing of the program, nothing of JAX."""
