"""Development tools for the port: run from the repository root with
``python -m tools.<name>``. Nothing in the packages imports them."""
