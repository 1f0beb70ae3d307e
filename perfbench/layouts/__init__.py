"""The program's parameter layouts, built from the reference's named leaves."""
