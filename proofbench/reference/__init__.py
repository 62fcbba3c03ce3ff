"""The benchmark's plain reference: it judges the program's proofs.

Plain Python and NumPy only; it imports nothing of the program.
"""
