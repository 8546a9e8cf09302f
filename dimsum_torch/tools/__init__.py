"""Dataset tools of the port (`tools/` of the JAX package), each run as
`python -m dimsum_torch.tools.<name>`."""
