"""Core PDES dynamics of the port: events, horizon, engine, measurement."""
