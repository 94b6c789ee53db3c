"""The plain reference the benchmark's check holds the program to. It
imports torch and numpy only: nothing of the program, nor JAX."""
