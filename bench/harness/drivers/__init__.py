"""One general loop per entry point of the program; a traffic mix names
the loop in its ``driver`` key and gives its parameters."""
