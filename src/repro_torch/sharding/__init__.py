"""Sharding rules of the port: logical axes to mesh axes."""
