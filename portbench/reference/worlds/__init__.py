"""Reference worlds, one module a world kind (a configuration's "world")."""
