"""Server, client, buffer and resource layers of the port."""
