"""Plain references of what the program computes. They import nothing of
the program, of JAX or of the JAX package."""
