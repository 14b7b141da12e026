"""Control-plane pieces the port needs: the object store."""
