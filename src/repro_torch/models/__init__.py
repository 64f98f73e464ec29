"""Models of the port: parameter trees, MIND serving and the dense GQA
transformer's decode path."""
