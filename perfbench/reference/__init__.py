"""The plain float32 reference and the comparison that decides
``correct``; nothing here imports the program."""
