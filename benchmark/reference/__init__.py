"""Plain reference of the live device step, one module a decoder kind."""
