"""Frozen copies of the port's plain modules at commit 7a69f88: the plain reference's building blocks, importing nothing of the program."""
