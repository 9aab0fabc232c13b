"""Model families: each module builds the program's model, names its reference, and maps their layouts."""
