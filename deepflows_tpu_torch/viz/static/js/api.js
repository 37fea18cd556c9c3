/* HTTP API layer (the role of the reference's axios wrapper + endpoint
 * module, Visualization_frontend/src/utils/request.ts and
 * src/api/modules/training.ts).  One `request` primitive with JSON
 * encode/decode and typed errors; endpoint functions on top.
 */

export class ApiError extends Error {
  constructor(status, body) {
    super(`HTTP ${status}: ${JSON.stringify(body)}`);
    this.status = status;
    this.body = body;
  }
}

async function request(path, { method = 'GET', body } = {}) {
  const res = await fetch(path, {
    method,
    headers: body !== undefined ? { 'Content-Type': 'application/json' } : {},
    body: body !== undefined ? JSON.stringify(body) : undefined,
  });
  const data = await res.json().catch(() => ({}));
  if (!res.ok) throw new ApiError(res.status, data);
  return data;
}

export const api = {
  getModels: () => request('/api/models'),
  getHistory: () => request('/api/history'),
  startTraining: (config) =>
    request('/api/train/start', { method: 'POST', body: config }),
  stopTraining: () => request('/api/train/stop', { method: 'POST' }),
  validateModel: (layers, inputShape) =>
    request('/api/model/validate', {
      method: 'POST',
      body: { layers, input_shape: inputShape },
    }),
};
