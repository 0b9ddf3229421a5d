"""Privacy stack of the port: fixed-point codec, dealer masking, DP and the
RDP accountant."""
