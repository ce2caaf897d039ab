"""Plain references of the configurations, free of the program."""
