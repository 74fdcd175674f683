"""Plain references that judge the program; they import nothing of it."""
