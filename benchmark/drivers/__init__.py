"""One general driver per entry point of the program; a traffic file names
its driver and gives its parameters."""
