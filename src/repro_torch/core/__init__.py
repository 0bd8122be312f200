"""Server, client, buffer and resource layers of the port, and the
transformer zoo's serving steps (``pod.py``)."""
