"""The entries a traffic file names by its "driver": `train`."""
