"""The plain reference: AL-iLQR and its models in plain PyTorch, with no
import of the program under test."""
