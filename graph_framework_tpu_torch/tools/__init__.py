"""Input-generation tooling: numpy spline-table builders for EFIT inputs."""
