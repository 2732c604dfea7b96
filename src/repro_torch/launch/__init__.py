"""Step functions and the serving entry point of the port (port of
`repro.launch`: `steps` and `serve`)."""
