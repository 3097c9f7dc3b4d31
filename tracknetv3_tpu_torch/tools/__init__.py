"""Host tools of the port: the error-analysis and label-correction web UIs."""
