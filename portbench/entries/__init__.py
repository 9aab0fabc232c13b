"""Entries: what one call of a traffic mix does to the program, and how its answers are judged."""
