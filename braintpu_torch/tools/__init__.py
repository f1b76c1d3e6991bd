"""Entry points of the port that are not the CLI."""
