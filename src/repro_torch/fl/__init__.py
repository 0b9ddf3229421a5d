"""Federated-learning core of the port: ParamSpace rows, client training
and the server update."""
